"""Every output token the window's steps gave (first tokens included),
over the window's seconds."""


def read(run):
    return run.account.output_tokens / run.account.seconds
