"""One flag for the kernel dispatchers: `on` is True while either
telemetry plane (the metrics registry or the trace writer) is on, so a
dispatcher pays one attribute read and one boolean check when both are
off. `registry.enable/disable` and `trace.enable/disable/save` keep it
current."""
on = False


def refresh() -> None:
    global on
    from repro_torch.obs import registry, trace
    on = registry.enabled() or trace.enabled()
