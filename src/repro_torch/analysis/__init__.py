"""Analysis helpers of the port (named RNG streams)."""
