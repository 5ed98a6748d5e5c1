"""The device reduce state and its exact host lane."""
