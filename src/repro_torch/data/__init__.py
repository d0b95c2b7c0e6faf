"""Data helpers of the port (`repro.data`)."""
