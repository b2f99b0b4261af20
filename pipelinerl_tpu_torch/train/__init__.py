"""Training: RL losses, advantages, packing and the trainer loop."""
