from .decode import decode_detections, extract_dets_from_outputs

__all__ = ["decode_detections", "extract_dets_from_outputs"]
