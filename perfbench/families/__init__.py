"""One module a model family: the program under test and its reference."""
