"""LC104 fixture: config objects mutated after construction."""


def tweak(cfg, run_config):
    cfg.num_nodes = 4096  # LC104: attribute store on a config
    object.__setattr__(run_config, "zone_size", 16)  # LC104: frozen bypass
    return cfg
