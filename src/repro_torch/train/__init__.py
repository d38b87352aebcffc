"""Training and serving steps of the model substrate (mirrors repro.train):
AdamW, the train / serve steps, checkpoints and the fault-tolerant loop."""
