"""The benchmark's plain reference: ground plane fitting in NumPy
(``gpf``), exact radius-graph components in plain PyTorch
(``radius_cc``) and the plane geometry that judges outlines
(``geometry``). It imports nothing of the program under test."""
