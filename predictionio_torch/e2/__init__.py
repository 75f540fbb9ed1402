"""Engine-building helpers shared by templates — the port of
``predictionio_tpu/e2``, reduced to `evaluation.cross_validation_splits`
(the rest waits for ROADMAP item 22)."""
