"""The training substrate: optimizers, bitplane gradient compression, the
train and serve steps, progressive bitplane checkpoints and the
fault-tolerance harness."""
