"""Numeric primitives and the kernel wrappers (monodetr_tpu/ops)."""
