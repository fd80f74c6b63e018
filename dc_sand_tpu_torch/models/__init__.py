"""Engine compositions: the F-engine (``fengine``) and the fx streaming
step (``pipeline``)."""
