from .eval import get_official_eval_result

__all__ = ["get_official_eval_result"]
