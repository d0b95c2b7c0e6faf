"""The model zoo of the port (`repro.models`): the dense, moe, ssm,
hybrid, encdec and vlm families, and their sharding rules."""
