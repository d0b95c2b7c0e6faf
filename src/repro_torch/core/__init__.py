"""State, controller and round functions of the port (`repro.core`)."""
