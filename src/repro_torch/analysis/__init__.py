# Behavioural contract checks of the port (``certify``): the env half of
# the reference's ``repro.analysis``, run as probes instead of a jaxpr walk.
