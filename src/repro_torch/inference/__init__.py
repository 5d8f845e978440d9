"""Parameters and the ensemble forecast engine."""
