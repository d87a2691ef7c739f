"""Random streams that a traced program can carry."""
