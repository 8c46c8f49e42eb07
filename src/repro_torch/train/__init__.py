"""The train step (counterpart of ``repro/train``; its sharding specs wait
for the sharded trainer, see ROADMAP)."""
