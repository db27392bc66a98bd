"""Works-directory loading (the port's copy of scrape.clean)."""
