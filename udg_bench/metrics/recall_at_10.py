"""recall_at_10: mean recall@10 of the judged sample of answers against the
reference's exact filtered top-10 (``check.readings``)."""


def read(ctx):
    return ctx["recall"]
