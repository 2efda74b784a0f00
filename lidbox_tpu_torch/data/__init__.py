"""Serving data pipeline of the port: host dataset, chunking and device
feature extraction (counterpart of ``lidbox_tpu.data``)."""
