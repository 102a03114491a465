"""Training: AdamW with float32, bfloat16 or q8 moments, and the train step."""
