"""After training: the brain maps and their NIfTI I/O."""
