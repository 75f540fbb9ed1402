"""Engine templates ported from predictionio_tpu/templates."""
