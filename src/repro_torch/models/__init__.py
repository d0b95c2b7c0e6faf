"""The model zoo of the port (`repro.models`): the dense, moe, ssm and
hybrid families."""
