"""torch.cuda.max_memory_allocated over the program's set-up, warm-up and
window (read before the reference runs), in GiB."""


def read(record):
    if record["kind"] != "train" or "peak_bytes" not in record:
        return None
    return record["peak_bytes"] / 2 ** 30
