# Elastic env-slot pools (``elastic``); the env-axis sharding of the
# reference's ``distribution`` package waits for the multi-device slice.
