"""Distribution: the sharding rule tables and the policy context."""
