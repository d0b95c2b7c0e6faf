"""Meshes of the port (`repro.launch`)."""
