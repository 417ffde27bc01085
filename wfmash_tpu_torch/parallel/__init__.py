"""Several devices in one process: the mesh, the sharded programs and the
multi-device dry run (counterpart of wfmash_tpu/parallel/ and of
__graft_entry__.py)."""
