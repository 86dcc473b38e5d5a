"""Training volumes completed per second: steps x accum x batch over the whole
untraced window's time."""


def read(run):
    return run.window['samples'] / run.window['seconds']
