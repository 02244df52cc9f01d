"""Tree model and the boosting driver."""
