"""Data on the host, in numpy: synthetic inputs made from a seed, the
deterministic loader, and the real-IMDB and real-MNIST hooks."""
