"""Adam and its learning-rate schedules over named tensors."""
