"""Plain references of the port's models, in plain ``torch`` and float32,
that tests hold the program against; they import nothing of the port."""
