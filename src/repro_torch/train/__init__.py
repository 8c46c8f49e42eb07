"""The train step and its sharding rules (counterpart of ``repro/train``)."""
