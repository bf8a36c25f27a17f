"""The KITTI data pipeline.  The dataset and the loader load on first use,
so that `kitti_utils` (the decode's calibration) imports without the image
libraries (PIL, cv2) that the dataset needs."""

__all__ = ["KITTIDataset", "build_dataloader"]


def __getattr__(name):
    if name == "KITTIDataset":
        from .kitti_dataset import KITTIDataset
        return KITTIDataset
    if name == "build_dataloader":
        from .loader import build_dataloader
        return build_dataloader
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
