"""Cross-process plumbing of the port's worker mode: the shared-memory
rings and the worker stats block (``shm_ring``), copied from the reference.
The reference's device-mesh modules (``mesh``, ``sharded_match``,
``mesh_match``) are not ported yet (ROADMAP Queue 1 item 8)."""
