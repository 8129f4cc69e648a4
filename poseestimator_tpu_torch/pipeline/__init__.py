"""Per-frame pipeline: object windows, the track step, the fused frame."""
