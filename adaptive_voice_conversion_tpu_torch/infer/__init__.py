"""One-shot voice conversion."""
