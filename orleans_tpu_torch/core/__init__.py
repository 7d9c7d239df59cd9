"""Grain programming-model metadata (subset needed by vector grains)."""
