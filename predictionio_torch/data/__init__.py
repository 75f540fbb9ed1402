"""Event data: BiMap, columnar event batches and the events-file store."""
