"""Synchronous-parallel RBCD and its sharded certificate (the scaling mode)."""
