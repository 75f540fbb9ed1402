"""Train and deploy workflows."""
