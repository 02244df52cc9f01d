"""Tree learners."""
