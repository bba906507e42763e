"""Logger sinks."""
