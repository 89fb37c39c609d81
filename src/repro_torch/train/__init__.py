"""The LM training runtime: checkpoints, the fault-tolerant driver and the
train steps."""
