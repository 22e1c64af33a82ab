# Elastic env-slot pools (``elastic``) and the env half of the reference's
# ``distribution.sharding`` (``sharding``: the env mesh and placement).
