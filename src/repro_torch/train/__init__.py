"""Training of the port: AdamW, the training step with LB ingest, the
trainer loop (the JAX package's ``repro/train/``)."""
