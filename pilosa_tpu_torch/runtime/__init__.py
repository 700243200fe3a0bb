"""Process-wide runtime layers of the port (the result cache)."""
