"""Host seconds of ``plan()`` and the first ``bind()``, each ending in a
synchronise."""


def read(ctx):
    spans = ctx.get("spans", {})
    if "plan_s" not in spans:
        return None
    return spans["plan_s"] + spans["bind_s"]
