"""Model substrate of the port: config, layers and the dense family's
prefill/decode path (``model.py``)."""
