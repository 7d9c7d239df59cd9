"""The silo runtime of the port: messaging, the in-process transport, the
ring, membership, the runtime client, the dispatcher and the silo, as far
as the clustered vector data plane needs them."""
