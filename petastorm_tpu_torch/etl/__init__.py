"""Dataset metadata: footer read side and the streaming writer."""
