"""The joint CTC/attention training step."""
