"""Asynchronous checkpointing with a continuation-based commit."""
