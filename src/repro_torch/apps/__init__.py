"""Application subsystems built on the solver stack (paper §VI: "plans to
extend this work towards full applications")."""
