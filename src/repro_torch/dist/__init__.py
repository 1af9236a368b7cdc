"""Distribution helpers of the port: int8 gradient compression with error
feedback (``compression``); the sharding resolver waits for the port's
multi-device slice."""
