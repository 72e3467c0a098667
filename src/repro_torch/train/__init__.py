"""The training substrate: optimizers, bitplane gradient compression, the
train step, progressive bitplane checkpoints and the fault-tolerance
harness."""
