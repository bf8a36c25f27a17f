"""95th percentile, over every frame of the window, of a frame's time from
its issue until its KITTI rows are on the host, in ms."""

import numpy as np


def read(record):
    if record["kind"] != "stream":
        return None
    return 1e3 * float(np.percentile(record["window"]["latencies_s"], 95))
