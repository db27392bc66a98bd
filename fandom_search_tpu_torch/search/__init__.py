"""Index, engine, oracle, chaining and reporting."""
