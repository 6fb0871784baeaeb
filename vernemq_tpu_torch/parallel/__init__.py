"""The port's multi-device and cross-process plumbing: the device mesh and
the placement of the matcher state (``mesh``), the sharded matcher and its
seat (``sharded_match``), the mesh-native matcher with slice-routed deltas
and its seat (``mesh_match``), and worker mode's shared-memory rings and
stats block (``shm_ring``, copied from the reference)."""
