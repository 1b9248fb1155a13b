"""The plain reference of a BASD train step: float32 PyTorch that imports
nothing of the program and takes nothing it made."""
