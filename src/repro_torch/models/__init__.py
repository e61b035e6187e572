"""Dense-GQA transformer layers, attention and cached forward, as torch ops."""
