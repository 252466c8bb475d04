"""Step builders and the token-loop server (port of `repro.launch`)."""
