"""setup_s: seconds from the process's start to the window's opening
(imports, the card's start-up, the inputs, the program's set-up and the
warm-up unit), by the host clock."""


def read(ctx):
    return ctx["setup_s"]
