"""The meshed half of the port: collectives over a mesh's axes (``comm``)
and the logical-axis sharding rules (``sharding``)."""
