"""Launchers of the port (`repro.launch`): meshes, the input stand-ins
of the sharding rules, and the serve and train CLIs."""
