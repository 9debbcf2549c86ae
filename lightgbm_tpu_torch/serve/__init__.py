"""Serving (counterpart of lightgbm_tpu/serve/): so far only the
model-derived bin space of ``packing.py``, which lets a loaded model
predict on the device."""
