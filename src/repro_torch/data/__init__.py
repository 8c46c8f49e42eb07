"""Synthetic token batches and the continuation-driven prefetch."""
