"""The model zoo of the port (`repro.models`): the dense family."""
