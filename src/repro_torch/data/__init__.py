"""Ingest path: DAQ traffic, segmentation, WAN transport, reassembly."""
