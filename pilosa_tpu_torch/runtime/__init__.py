"""Process-wide runtime layers of the port: the result cache, tiered
device residency, the prefetcher and the stack prewarm."""
