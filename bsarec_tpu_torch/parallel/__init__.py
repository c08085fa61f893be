"""The vocab-sharded item table's lookup, CE and top-k (counterpart of
`bsarec_tpu/parallel/`)."""
