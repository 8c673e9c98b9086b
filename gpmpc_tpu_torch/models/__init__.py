"""GP dynamics model."""
