from . import markov
