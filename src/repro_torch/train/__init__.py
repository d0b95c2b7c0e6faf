"""Step functions of the port (`repro.train`)."""
