"""Engine compositions: the F-engine (``fengine``), the fengine, fx and
beam streaming step (``pipeline``) and beam-steering weights
(``steering``)."""
