"""The plain reference a run's outputs are judged against: written anew in
PyTorch and numpy, importing nothing of the program."""
