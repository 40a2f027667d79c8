"""The plain reference: plain torch, no code of the program."""
