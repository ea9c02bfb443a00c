"""The training step: render, loss, backward, Adam, densification statistics."""
