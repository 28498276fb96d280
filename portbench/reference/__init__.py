"""The plain reference that decides `correct`: the PIC step and its
diagnostics (`pic`) and a reader of what was written (`bp4`). Imports
nothing of the program."""
