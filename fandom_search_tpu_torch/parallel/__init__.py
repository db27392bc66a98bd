"""The works x script device grid, the sharded engine and its sharded bucketed prefilter."""
