"""Seconds from process start to the first timed step."""


def read(record):
    return record["setup_s"]
