"""The plain reference: PyTorch alone, no kernel, no import of the port.

`layers` holds the operations a configuration's forward is written in,
`kfac` the exact-Fisher KFAC factors, `posterior` the eigendecompositions,
the log marginal likelihood, the prior tuning and the probit predictive.
Every function takes the weights and inputs the benchmark made; nothing
the program derived is read, except where a function is named `judge_*`.
"""
