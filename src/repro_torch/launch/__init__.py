"""Launchers of the port (`repro.launch`): meshes and the serve CLI."""
