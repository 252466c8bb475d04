"""Step functions, the token-loop server, the trainer and the
assigned input shapes (port of `repro.launch`)."""
