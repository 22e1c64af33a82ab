# The port's contract gate, the counterpart of the reference's
# repro.analysis: the policy certificate (certify), the decision loop's and
# the train step's checks as behavioural probes (check), and the AST lint
# of host code (lint).
