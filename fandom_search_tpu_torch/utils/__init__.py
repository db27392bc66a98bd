"""Host utilities (synthetic corpora)."""
