"""Step factories of the port: the serving steps (the train step comes
with the training slice)."""
