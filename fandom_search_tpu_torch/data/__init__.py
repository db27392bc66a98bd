"""Host data modules (hashing, tokenizing, parsing, shingling)."""
