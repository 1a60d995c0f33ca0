"""climt_tpu: an accelerator-native Earth-system modeling framework.

Composable, units-aware model components (radiation, convection,
condensation, boundary layer, surface, ice) built on JAX/XLA/Pallas, with a
GFS-style spectral dynamical core sharded over GPU device meshes.

Provides the full capability surface of the reference CliMT/climt toolkit
(see SURVEY.md at the repo root) with a compiled, SPMD-first execution model.
"""

from .core.base_components import (
    ComponentBase, ConstantDiagnosticComponent, ConstantTendencyComponent,
    DiagnosticComponent, ImplicitTendencyComponent, Stepper,
    TendencyComponent,
)
from .core.constants import (
    ConstantNotFoundError, constant_names, get_constant,
    get_constants_string, list_available_constants, reset_constants,
    set_constant, set_constants_from_dict,
)
from .core.dataarray import DataArray
from .core.grid import (
    HybridSigmaPressureDiagnosticComponent, gaussian_latitudes, get_grid,
    hybrid_sigma_pressure_coefficients,
)
from .core.initialization import (
    ConstantDefaultValue, PressureFunctionDiagnosticComponent,
    aggregate_input_properties, default_values, get_default_state,
    get_init_diagnostic, init_ozone,
)
from .core.properties import (
    InvalidPropertyDictError, InvalidStateError,
    combine_component_properties, extract_arrays, restore_arrays,
)
from .core.steppers import (
    AdamsBashforth, Leapfrog, SSPRungeKutta, TendencyStepper,
)
from .core.units import (
    UnitError, conversion_factor, is_valid_unit, units_are_compatible,
    units_are_same,
)
from .core.util import (
    bolton_dqsat_dT, bolton_q_sat, calculate_q_sat, get_interface_values,
    jax_version_of, mass_to_volume_mixing_ratio, numpy_version_of,
)
from .core.wrappers import (
    ScalingWrapper, TimeDifferencingWrapper, UpdateFrequencyWrapper,
)

from .core.tracers import (
    TracerPacker, get_tracer_names, get_tracer_unit_dict, register_tracer,
    reset_packers, reset_tracers,
)
from .io.monitors import (
    NetCDFMonitor, PlotFunctionMonitor, RestartMonitor,
)

from .components import (
    BergerSolarInsolation, BucketHydrology, DcmipInitialConditions,
    DryConvectiveAdjustment, EmanuelConvection,
    Frierson06LongwaveOpticalDepth, GrayLongwaveRadiation,
    GridScaleCondensation, HeldSuarez, IceSheet, Instellation,
    DataOcean, EmanuelConvectionPython, LandIce, LandMask, SeaIce, SecondBEST,
    SimpleBoundaryLayer,
    RRTMGLongwave, RRTMGShortwave, SimplePhysics, SlabSurface,
)
from .dycore.gfs import GFSDynamicalCore
from .dycore.spectral_dynamics import SpectralDycore

__version__ = '0.1.0'

# The reference overrides the model-top pressure at import
# (/root/reference/climt/__init__.py:18); reproduce for grid parity.
set_constant('top_of_model_pressure', 20., 'Pa')
