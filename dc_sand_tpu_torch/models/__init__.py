"""Engine compositions: the F-engine (``fengine``), the fengine, fx and
beam streaming step on one device or a mesh (``pipeline``), the one-shot
FX compositions and time-sharded F-engine (``fx``) and beam-steering
weights (``steering``)."""
