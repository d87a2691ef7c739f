"""Training of the port: the CMLPL trainer and its epoch driver."""
