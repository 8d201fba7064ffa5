"""Plain PyTorch references of the benchmark's models: SuperPoint,
LightGlue and SuperGlue as their publications describe them, and the
epipolar arithmetic of verification. They import nothing of the measured
program and take nothing it made; they run in float32 with TF32 off, or,
as the controls, with the inputs of every product rounded to float8
(``lowp.py``)."""
